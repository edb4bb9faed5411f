"""CLI: COLMAP text model -> transforms_<scene>.json (counterpart of
``nerfjax/cli/colmap2nerf.py``, with ``--device``).

    python -m nerfjax_torch.cli.colmap2nerf --cfg_path cfg/grass_scene.yml [--mode auto]

Default mode "auto" is the reference's canonical corrected pipeline
(scripts/colmap2nerf_corrected.py, wired into the GUI launcher); mode
"euler" reproduces the normalize_with_aabb variant (config Euler rotations
+ near/far bounds). The outlier filters run on the card (``--device cuda``,
the default; it raises without one). After nerfjax's output the last line
is ``Stages: {json}``: each stage's seconds (read, outlier_filter with its
kNN alone, normalize_convert, aabb, write, wall) and the points read and
kept.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    t0 = time.perf_counter()
    p = cfg_parser("Convert COLMAP model to NeRF transforms JSON")
    p.add_argument("--mode", default="auto", choices=["auto", "auto+z", "euler"])
    args = p.parse_args()
    cfg = load_cfg(args)

    from nerfjax_torch.colmap import colmap_to_nerf, write_transforms_json

    result = colmap_to_nerf(cfg, mode=args.mode, device=args.device)
    stats = result["stages"]
    out = Path(f"transforms_{cfg.scene_name}.json")
    t1 = time.perf_counter()
    write_transforms_json(result["transform"], out)
    stats["write"] = time.perf_counter() - t1

    v = result["validation"]
    if v.get("passed", True):
        print("All validations PASSED")
    else:
        print("Some validations FAILED - review the transformations!")
    stats["wall"] = time.perf_counter() - t0

    if cfg.get("visualize", False):
        try:
            from nerfjax_torch.gui.viewers import display_scene

            display_scene(result["points"], result["rgbs"],
                          result["transform"]["frames"],
                          result["transform"]["scene_aabb"])
        except Exception as e:  # the viewer's dependencies are optional; the JSON is written
            print(f"[visualize] skipped: {e}")
    print("Stages: " + json.dumps(stats))


if __name__ == "__main__":
    main()
