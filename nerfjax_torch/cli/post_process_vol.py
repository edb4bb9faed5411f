"""CLI: AABB-slice the occupancy volume into volume_sliced.pth (counterpart
of ``nerfjax/cli/post_process_vol.py``, same flags; host code, no card).

    python -m nerfjax_torch.cli.post_process_vol --cfg_path cfg/blender_scene_fast.yml
"""

from __future__ import annotations

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    p = cfg_parser("Slice occupancy volume by scene AABB", device=False)
    p.add_argument("--visualize", type=str, default=None, choices=["raw", "sliced"])
    args = p.parse_args()
    cfg = load_cfg(args)

    from nerfjax_torch.postprocess import post_process

    result = post_process(cfg)
    if args.visualize:
        try:
            from nerfjax_torch.gui.viewers import display_pointcloud

            display_pointcloud(result["points"], result["rgbs"])
        except Exception as e:
            print(f"[visualize] skipped: {e}")


if __name__ == "__main__":
    main()
