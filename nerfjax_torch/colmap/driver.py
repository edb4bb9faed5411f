"""COLMAP SfM driver: shells out to the external COLMAP binary; the port's
copy of ``nerfjax/colmap/driver.py`` (the same command lines, stage for
stage; ``tests/test_torch_colmap.py``).

Cross-platform rebuild of scripts/run_colmap.py (the reference hardcodes
Windows COLMAP.bat + `cd /d`, run_colmap.py:11-27): feature_extractor ->
matcher -> mapper -> bundle_adjuster -> model_converter(TXT), failing loudly
on any stage (reference exits via do_system, run_colmap.py:9-14).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path


def _run(cmd: list[str], verbose: bool = True) -> None:
    if verbose:
        print("==== running:", " ".join(str(c) for c in cmd))
    result = subprocess.run(cmd)
    if result.returncode != 0:
        sys.exit(f"COLMAP stage failed ({result.returncode}): {' '.join(map(str, cmd))}")


def find_colmap(colmap_bin: str | None = None) -> str:
    for cand in ([colmap_bin] if colmap_bin else []) + ["colmap", "COLMAP.bat"]:
        if cand and shutil.which(cand):
            return cand
    raise FileNotFoundError(
        "COLMAP binary not found on PATH; install COLMAP or pass colmap_bin"
    )


def run_colmap(
    workspace: str | Path,
    image_dir: str | Path | None = None,
    colmap_bin: str | None = None,
    matcher: str = "exhaustive",
    camera_model: str = "SIMPLE_RADIAL",
    single_camera: bool = True,
    gpu: bool = False,
    verbose: bool = True,
) -> Path:
    """Run the full SfM chain; outputs colmap_text/{cameras,images,points3D}.txt
    under the workspace (the file contract the converters consume)."""
    workspace = Path(workspace)
    image_dir = Path(image_dir) if image_dir else workspace / "images"
    db = workspace / "database.db"
    sparse = workspace / "sparse"
    text_out = workspace / "colmap_text"
    sparse.mkdir(parents=True, exist_ok=True)
    text_out.mkdir(parents=True, exist_ok=True)

    colmap = find_colmap(colmap_bin)
    use_gpu = "1" if gpu else "0"

    _run(
        [
            colmap, "feature_extractor",
            "--database_path", str(db),
            "--image_path", str(image_dir),
            "--ImageReader.camera_model", camera_model,
            "--ImageReader.single_camera", "1" if single_camera else "0",
            "--SiftExtraction.use_gpu", use_gpu,
        ],
        verbose,
    )
    matcher_cmd = {
        "exhaustive": "exhaustive_matcher",
        "sequential": "sequential_matcher",
        "vocab_tree": "vocab_tree_matcher",
    }[matcher]
    _run(
        [colmap, matcher_cmd, "--database_path", str(db),
         "--SiftMatching.use_gpu", use_gpu],
        verbose,
    )
    _run(
        [
            colmap, "mapper",
            "--database_path", str(db),
            "--image_path", str(image_dir),
            "--output_path", str(sparse),
        ],
        verbose,
    )
    model0 = sparse / "0"
    _run(
        [
            colmap, "bundle_adjuster",
            "--input_path", str(model0),
            "--output_path", str(model0),
            "--BundleAdjustment.refine_principal_point", "1",
        ],
        verbose,
    )
    _run(
        [
            colmap, "model_converter",
            "--input_path", str(model0),
            "--output_path", str(text_out),
            "--output_type", "TXT",
        ],
        verbose,
    )
    return text_out
