"""CLI: render PNGs from a trained checkpoint on one card (counterpart of
``nerfjax/cli/render.py``, with the same flags plus ``--device``): the
frames recorded in the transforms JSON, or a turntable orbit of novel
poses, with the coarse->pdf->fine renderer.

    # re-render recorded frames 0 and 3
    python -m nerfjax_torch.cli.render --cfg_path cfg/scene.yml --frame 0 3

    # 8-view turntable orbit at radius 2.5
    python -m nerfjax_torch.cli.render --cfg_path cfg/scene.yml --orbit 8
"""

from __future__ import annotations

from pathlib import Path

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    p = cfg_parser("Render novel-view PNGs from a trained checkpoint")
    p.add_argument("--frame", type=int, nargs="*", default=None,
                   help="render these frame indices from the transforms JSON")
    p.add_argument("--orbit", type=int, default=None, help="render N novel look-at poses on a turntable orbit")
    p.add_argument("--radius", type=float, default=2.5, help="orbit radius (scene is normalized to [-1,1]^3)")
    p.add_argument("--height", type=float, default=1.2, help="orbit camera z")
    p.add_argument("--out", type=str, default=None, help="output dir (default <output_dir>/renders)")
    p.add_argument("--checkpoint", type=str, default=None, help="override cfg.checkpoint")
    p.add_argument("--samples", type=int, default=None, help="override cfg.N_samples")
    p.add_argument("--importance", type=int, default=None, help="override cfg.N_importance")
    args = p.parse_args()
    cfg = load_cfg(args)
    if not args.frame and not args.orbit:
        p.error("pass --frame indices and/or --orbit N")
    # `is not None`, so an explicit 0 errors instead of taking the cfg's value
    n_samples = args.samples if args.samples is not None else int(cfg.get("N_samples", 64))
    n_importance = args.importance if args.importance is not None else int(cfg.get("N_importance", 128))
    if n_samples < 1:
        p.error(f"--samples must be >= 1 (got {n_samples})")
    if n_importance < 1:
        p.error(f"--importance must be >= 1 (got {n_importance})")

    import json

    import numpy as np
    from PIL import Image

    from nerfjax_torch.checkpoint import load_field
    from nerfjax_torch.extract import resolve_device
    from nerfjax_torch.render_image import orbit_poses, render_image

    field = load_field(args.checkpoint or cfg.checkpoint, cfg, device=resolve_device(args.device))
    with open(cfg.transforms_json) as f:
        meta = json.load(f)
    H, W = int(meta["h"]), int(meta["w"])
    K = np.array(meta["K"], np.float32)
    out_dir = Path(args.out or Path(cfg.output_dir) / "renders")
    out_dir.mkdir(parents=True, exist_ok=True)

    jobs: list[tuple[str, np.ndarray]] = []
    for i in args.frame or []:
        jobs.append((f"frame_{i:04d}.png", np.array(meta["frames"][i]["transform_matrix"], np.float32)))
    if args.orbit:
        poses = orbit_poses(args.orbit, radius=args.radius, height=args.height)
        jobs += [(f"orbit_{i:04d}.png", poses[i]) for i in range(args.orbit)]
    for name, c2w in jobs:
        img = render_image(field, K, c2w, H, W, n_samples=n_samples, n_importance=n_importance,
                           white_bg=bool(cfg.get("white_bg", False)))
        path = out_dir / name
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
