"""CLI: export the sliced volume to napari/ParaView tiffs and VTI
(counterpart of ``nerfjax/cli/write_format.py``, same flags; host code, no
card).

    python -m nerfjax_torch.cli.write_format --cfg_path cfg/blender_scene_fast.yml
"""

from __future__ import annotations

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    p = cfg_parser("Export volume data to tiff/vti formats", device=False)
    p.add_argument("--grid_size", type=int, default=512)
    p.add_argument("--visualize", choices=["binary", "rgb", "both"], default=None)
    args = p.parse_args()
    cfg = load_cfg(args)

    from nerfjax_torch.postprocess import write_formats

    write_formats(cfg, grid_size=args.grid_size)
    if args.visualize:
        print("[visualize] napari not bundled in this environment; "
              "open the written .tif files in napari to inspect")


if __name__ == "__main__":
    main()
