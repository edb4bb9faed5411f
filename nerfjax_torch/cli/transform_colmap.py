"""CLI: re-center a COLMAP model in place (counterpart of
``nerfjax/cli/transform_colmap.py``, same flags; host code, no card).

    python -m nerfjax_torch.cli.transform_colmap --cfg_path cfg/grass_scene.yml [--no_rotate]
"""

from __future__ import annotations

from pathlib import Path

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    p = cfg_parser("Re-center COLMAP model at percentile centroid", device=False)
    p.add_argument("--no_rotate", action="store_true",
                   help="skip aligning +Z with the mean camera view direction")
    args = p.parse_args()
    cfg = load_cfg(args)
    from nerfjax_torch.colmap.transform import recenter_colmap_model

    workdir = Path(cfg.get("colmap_dir", f"data/{cfg.scene_name}")) / "colmap_text"
    recenter_colmap_model(workdir, rotate_to_mean_view=not args.no_rotate)


if __name__ == "__main__":
    main()
