"""CLI: extract the colored occupancy volume (counterpart of
``nerfjax/cli/extract_vol.py``, with the same flags plus ``--device``).

    python -m nerfjax_torch.cli.extract_vol --cfg_path cfg/blender_scene_tuned.yml

Several cards: one process per card, joined as the train CLI's are
(``init_distributed``); the grid is split across them and rank 0 writes
the volume.
"""

from __future__ import annotations

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    p = cfg_parser("Extract binary occupancy volume from trained NeRF")
    p.add_argument("--resolution", "-r", type=int, default=None,
                   help="grid resolution (default: cfg.volume_resolution)")
    p.add_argument("--bounds", nargs=2, type=float, default=[-1.0, 1.0])
    p.add_argument("--batch-size", "-b", type=int, default=8192,
                   help="accepted for reference-CLI parity; the fine pass "
                        "queries 8192 cells (524,288 points) per call")
    p.add_argument("--view-direction", nargs=3, type=float, default=[0.0, 0.0, -1.0])
    p.add_argument("--exact", action="store_true",
                   help="exhaustive grid sweep instead of hierarchical refine")
    p.add_argument("--dense-fetch", action="store_true",
                   help="fetch the full dense RGB volume from the device even in "
                        "hierarchical mode (default: occupied-voxel-compacted "
                        "fetch; unoccupied RGB comes back as zeros)")
    p.add_argument("--coarse-full", action="store_true",
                   help="run the hierarchical coarse mark pass through the full "
                        "rgb+sigma head (default: the density-only kernel when "
                        "the sparse fetch is active)")
    p.add_argument("--coarse-ss", type=int, default=None, choices=[1, 2],
                   help="coarse-pass subsamples per cell per axis (default: 1 "
                        "under the sparse fetch, else 2)")
    p.add_argument("--density-only", action="store_true",
                   help="store only occupancy (zeroed RGB)")
    p.add_argument("--format", choices=["pth", "npy"], default="pth",
                   help="npy writes occupancy_volume.npy + metadata.json next to the .pth path")
    p.add_argument("--suggest-bounds", action="store_true",
                   help="print camera-pose-derived sampling bounds and exit")
    p.add_argument("--visualize", action="store_true",
                   help="show a 3-D preview of the extracted occupied voxels")
    p.add_argument("--viz-max-points", type=int, default=200_000,
                   help="subsample cap for the preview scatter")
    args = p.parse_args()
    if args.resolution is not None and args.resolution <= 0:
        raise ValueError("Resolution must be positive")
    if args.bounds[0] >= args.bounds[1]:
        raise ValueError("Invalid bounds: min must be less than max")
    from nerfjax_torch.parallel import init_distributed

    lead = init_distributed(backend="gloo" if args.device == "cpu" else None)[0] == 0
    cfg = load_cfg(args)

    import json
    from pathlib import Path

    import numpy as np

    if args.suggest_bounds:
        with open(cfg.transforms_json) as f:
            meta = json.load(f)
        cams = np.array([np.array(fr["transform_matrix"])[:3, 3] for fr in meta["frames"]])
        lo = float(np.floor(cams.min() * 10) / 10)
        hi = float(np.ceil(cams.max() * 10) / 10)
        m = max(abs(lo), abs(hi))
        print(f"Camera position range: [{cams.min():.3f}, {cams.max():.3f}]")
        print(f"Suggested bounds: --bounds {-m:.1f} {m:.1f}")
        return

    from nerfjax_torch.extract import extract_volume, save_volume

    vol = extract_volume(
        cfg,
        resolution=args.resolution,
        bounds=tuple(args.bounds),
        view_direction=tuple(args.view_direction),
        device=args.device,
        hierarchical=False if args.exact else None,
        sparse_fetch=False if args.dense_fetch else None,
        coarse_density_only=False if args.coarse_full else None,
        coarse_supersample=args.coarse_ss,
    )
    if not lead:
        return
    if args.density_only:
        vol["rgb_volume"] = vol["rgb_volume"] * 0
        vol["metadata"]["density_only"] = True

    if args.format == "npy":
        base = Path(cfg.volume_output_path).with_suffix("")
        np.save(f"{base}_occupancy.npy", vol["occupancy_volume"])
        if not args.density_only:
            np.save(f"{base}_rgb.npy", vol["rgb_volume"])
        with open(f"{base}_metadata.json", "w") as f:
            json.dump(vol["metadata"], f, indent=2)
        print(f"Saved npy volume to {base}_occupancy.npy")
    else:
        save_volume(vol, cfg.volume_output_path)
    print("EXTRACTION COMPLETED SUCCESSFULLY!")

    if args.visualize:
        from nerfjax_torch.gui.viewers import display_pointcloud
        from nerfjax_torch.postprocess import volume_to_points

        pts, rgbs = volume_to_points(
            vol["occupancy_volume"], vol["rgb_volume"], vol["metadata"].get("rgb_global_max")
        )
        display_pointcloud(pts, rgbs, title="extracted volume", max_points=args.viz_max_points)


if __name__ == "__main__":
    main()
