"""CLI: run COLMAP SfM (counterpart of ``nerfjax/cli/run_colmap.py``, same
flags; host code: it shells out to the COLMAP binary).

    python -m nerfjax_torch.cli.run_colmap --cfg_path cfg/grass_scene.yml [--gpu]
"""

from __future__ import annotations

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    p = cfg_parser("Run COLMAP feature/match/map/BA -> colmap_text", device=False)
    p.add_argument("--colmap_bin", type=str, default=None)
    p.add_argument("--matcher", default="exhaustive",
                   choices=["exhaustive", "sequential", "vocab_tree"])
    p.add_argument("--gpu", action="store_true")
    args = p.parse_args()
    cfg = load_cfg(args)
    from nerfjax_torch.colmap.driver import run_colmap

    out = run_colmap(
        cfg.get("colmap_dir", cfg.workspace),
        image_dir=cfg.get("tmp_image_dir", None) or cfg.image_dir,
        colmap_bin=args.colmap_bin,
        matcher=args.matcher,
        gpu=args.gpu,
    )
    print(f"COLMAP text model written to {out}")


if __name__ == "__main__":
    main()
