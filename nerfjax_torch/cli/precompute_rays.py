"""CLI: transforms JSON -> <scene>_ray_data.npz (counterpart of
``nerfjax/cli/precompute_rays.py``, with ``--device``).

    python -m nerfjax_torch.cli.precompute_rays --cfg_path cfg/blender_scene.yml

``transforms_json`` and ``rays_file`` default to the reference's names,
``transforms_<scene_name>.json`` and ``<scene_name>_ray_data.npz``. The rays
are made and intersected on the card (``--device cuda``, the default; it
raises without one). The last line is JSON: each stage's seconds and the
rays generated and kept.
"""

from __future__ import annotations

import json
import time

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    t0 = time.perf_counter()
    args = cfg_parser("Precompute cube-intersecting rays for all frames").parse_args()
    cfg = load_cfg(args)

    from nerfjax_torch.rays import precompute_rays_for_scene, save_ray_data

    stats: dict = {}
    data = precompute_rays_for_scene(cfg.get("transforms_json", f"transforms_{cfg.scene_name}.json"),
                                     device=args.device, stats=stats)
    print(f"{len(data['rays_o'])} rays with origins and directions.")
    filename = cfg.get("rays_file", f"{cfg.scene_name}_ray_data.npz")
    t1 = time.perf_counter()
    save_ray_data(data, filename)
    stats["write"] = time.perf_counter() - t1
    print(f"Saved rays data to {filename}.")
    stats["wall"] = time.perf_counter() - t0
    print("Stages: " + json.dumps(stats))


if __name__ == "__main__":
    main()
