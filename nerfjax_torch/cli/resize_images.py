"""CLI: resize or copy scene images (counterpart of
``nerfjax/cli/resize_images.py``, same flags; host code, no card).

    python -m nerfjax_torch.cli.resize_images --cfg_path cfg/grass_scene.yml
"""

from __future__ import annotations

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    args = cfg_parser("Resize or copy scene images", device=False).parse_args()
    from nerfjax_torch.utils.images import prepare_images

    prepare_images(load_cfg(args))


if __name__ == "__main__":
    main()
