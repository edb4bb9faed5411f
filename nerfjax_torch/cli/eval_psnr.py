"""CLI: held-out-view PSNR of a trained checkpoint on one card (counterpart
of ``nerfjax/cli/eval_psnr.py``, with the same flags plus ``--device``):
renders the frames of the transforms JSON with the fine field and prints
per-frame and mean PSNR.

    python -m nerfjax_torch.cli.eval_psnr --cfg_path cfg/scene.yml [--frames N]
"""

from __future__ import annotations

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    p = cfg_parser("Evaluate held-out PSNR of a trained checkpoint")
    p.add_argument("--frames", type=int, default=None, help="limit to first N frames")
    p.add_argument("--checkpoint", type=str, default=None, help="override cfg.checkpoint")
    args = p.parse_args()
    cfg = load_cfg(args)

    from nerfjax_torch.checkpoint import load_field
    from nerfjax_torch.extract import resolve_device
    from nerfjax_torch.render_image import eval_psnr

    field = load_field(args.checkpoint or cfg.checkpoint, cfg, device=resolve_device(args.device))
    eval_psnr(
        field,
        cfg.transforms_json,
        n_frames=args.frames,
        n_samples=int(cfg.get("N_samples", 64)),
        n_importance=int(cfg.get("N_importance", 128)),
        white_bg=bool(cfg.get("white_bg", False)),
    )


if __name__ == "__main__":
    main()
