"""Image preparation: LANCZOS resize or copy into the working directory; the
port's copy of ``nerfjax/utils/images.py`` (host code: PIL), whose files it
writes byte for byte (``tests/test_torch_colmap.py``).

Reimplements scripts/resize_images.py: when cfg.resize_images is set, every
image in cfg.image_dir is resized to cfg.newSize into cfg.tmp_image_dir,
otherwise files are copied through unchanged (reference: resize_images.py:42-67).
"""

from __future__ import annotations

import shutil
from pathlib import Path

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}


def process_images(
    image_dir: str | Path,
    out_dir: str | Path,
    new_size: tuple[int, int] | None = None,
    resize: bool = True,
    verbose: bool = True,
) -> int:
    """Resize (LANCZOS) or copy all images; returns the number processed."""
    from PIL import Image

    image_dir = Path(image_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    n = 0
    for src in sorted(image_dir.iterdir()):
        if src.suffix.lower() not in _IMAGE_EXTS:
            continue
        dst = out_dir / src.name
        if resize and new_size is not None:
            img = Image.open(src)
            img = img.resize(tuple(int(v) for v in new_size), Image.LANCZOS)
            img.save(dst)
        else:
            shutil.copy2(src, dst)
        n += 1
    if verbose:
        action = f"resized to {tuple(new_size)}" if resize and new_size else "copied"
        print(f"{action} {n} images from {image_dir} -> {out_dir}")
    return n


def prepare_images(cfg, verbose: bool = True) -> int:
    """Config-driven entry (reference resize_images.py main)."""
    out_dir = cfg.get("tmp_image_dir", None) or (Path(cfg.workspace) / "images_resized")
    return process_images(
        cfg.image_dir,
        out_dir,
        new_size=cfg.get("newSize", None),
        resize=bool(cfg.get("resize_images", True)),
        verbose=verbose,
    )
