"""The port's GUI logic and launcher (nerfjax_torch.gui) held to nerfjax's
(nerfjax.gui) on the same inputs: the twins of tests/test_gui_logic.py, the
YAML that save_config writes, and the launcher's loop."""

import importlib
import json
import os
import sys

import numpy as np
import pytest

from nerfjax import pth
from nerfjax.config import load_config as jax_load_config
from nerfjax.config import save_config as jax_save_config
from nerfjax.gui import logic as jax_logic
from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch.config import load_config, save_config
from nerfjax_torch.gui import logic

SCHEMA_KEYS = (
    "scene_name", "output_dir", "checkpoint_dir", "transforms_json",
    "rays_file", "volume_resolution", "workspace", "image_dir",
    "image_dir_resize", "tmp_image_dir", "resize_images", "newSize",
    "shift", "scale",
    "target_retention", "outlier_nb_neighbors", "outlier_std_ratio",
    "percentile_bbox", "aabb_adjust", "checkpoint", "volume_output_path",
    "aabb_slice", "sliced_vol_path", "colmap_dir", "batch_size",
    "num_epochs", "lr", "ngp", "nerf_type", "hidden_dim", "pos_L",
    "dir_L", "N_samples", "N_importance", "white_bg", "chunk_size",
    "use_memmap", "remove_below_aabb", "remove_upper_aabb",
)

# a YAML with exactly the reference creator's key set (tests/test_gui_logic.py)
REF_CFG = {
    "scene_name": "plot3", "output_dir": "./outputs/plot3", "checkpoint_dir": "${output_dir}/checkpoints",
    "transforms_json": "transforms_plot3.json", "rays_file": "plot3_ray_data.npz", "volume_resolution": 256,
    "remove_upper_aabb": True, "remove_below_aabb": False, "visualize": True,
    "image_dir_resize": "./data/plot3/images", "workspace": "tmp/plot3", "image_dir": "${workspace}/images",
    "tmp_image_dir": "tmp/plot3/images", "resize_images": True, "newSize": [800, 600], "shift": [0.1, 0.0, -0.2],
    "scale": 1.1, "target_retention": 0.9, "outlier_nb_neighbors": 25, "outlier_std_ratio": 1.5,
    "percentile_bbox": {"lower": 2.0, "upper": 98.0, "padding": 0.1},
    "aabb_adjust": {"aabb_min": [0, 0, 0.05], "aabb_max": [0, 0, -0.05]},
    "checkpoint": "${checkpoint_dir}/nerf_final.pth", "volume_output_path": "${output_dir}/volume.pth",
    "aabb_slice": True, "sliced_vol_path": "${output_dir}/volume_sliced.pth", "colmap_dir": "./data/plot3",
    "batch_size": 8192, "num_epochs": 5, "lr": 0.001, "ngp": False, "nerf_type": "large", "hidden_dim": 128,
    "pos_L": 8, "dir_L": 3, "N_samples": 32, "N_importance": 64, "white_bg": True, "chunk_size": 16384,
    "use_memmap": True,
}


def test_generate_config_dict_schema_roundtrip(tmp_path):
    values = {"scene_name": "plot7", "batch_size": 8192}
    cfg_dict = logic.generate_config_dict(values)
    assert cfg_dict == jax_logic.generate_config_dict(values)
    for key in SCHEMA_KEYS:
        assert key in cfg_dict, key
    p = tmp_path / "plot7.yml"
    save_config(cfg_dict, p)
    cfg = load_config(p)
    assert cfg.output_dir == "./outputs/plot7"
    assert cfg.checkpoint == "./outputs/plot7/checkpoints/nerf_final.pth"
    assert cfg.batch_size == 8192
    assert cfg.percentile_bbox.upper == 99.0
    assert cfg.to_dict() == jax_load_config(p).to_dict()

    assert "rotation" not in cfg_dict
    rot = {"scene_name": "x", "rotation": True, "angles": [10, 0, 0], "rot_order": [2, 1, 0],
           "rotation_initial": None}
    with_rot = logic.generate_config_dict(rot)
    assert with_rot == jax_logic.generate_config_dict(rot)
    assert with_rot["rotation"] is True and with_rot["rotation_initial"] is None


def test_reference_yaml_roundtrips_unchanged(tmp_path):
    p = tmp_path / "plot3.yml"
    save_config(REF_CFG, p)
    regenerated = logic.generate_config_dict(logic.values_from_config(load_config(p)))
    assert regenerated == jax_logic.generate_config_dict(jax_logic.values_from_config(jax_load_config(p)))
    assert set(regenerated) == set(REF_CFG)
    for k, v in REF_CFG.items():
        assert regenerated[k] == v, (k, regenerated[k], v)


@pytest.mark.parametrize("cfg", [REF_CFG, logic.generate_config_dict({"scene_name": "s", "occupancy_grid": True,
                                                                      "rotation_initial": None})],
                         ids=["reference", "generated"])
def test_save_config_file_equals_nerfjax(tmp_path, cfg):
    """The same dict gives the same bytes, and each package reads the
    other's file to the same config."""
    mine, theirs = tmp_path / "port.yml", tmp_path / "nerfjax.yml"
    save_config(cfg, mine)
    jax_save_config(cfg, theirs)
    assert mine.read_bytes() == theirs.read_bytes()
    assert load_config(theirs).to_dict() == jax_load_config(mine).to_dict()
    assert load_config(mine).to_dict(resolve=False) == cfg
    # a loaded config (a ConfigNode) is written with its raw interpolations
    again = tmp_path / "again.yml"
    save_config(load_config(mine), again)
    assert again.read_bytes() == mine.read_bytes()


def test_build_pipeline_commands():
    assert [label for label, _ in logic.PIPELINE_STEPS] == [label for label, _ in jax_logic.PIPELINE_STEPS]
    for (_, mine), (_, theirs) in zip(logic.PIPELINE_STEPS, jax_logic.PIPELINE_STEPS):
        assert mine == theirs.replace("nerfjax.cli.", "nerfjax_torch.cli.")
        importlib.import_module(mine)
    sel = [False] * len(logic.PIPELINE_STEPS)
    sel[4] = sel[5] = True
    cmds = logic.build_pipeline_commands("cfg/x.yml", sel)
    assert cmds == [[sys.executable, "-m", "nerfjax_torch.cli.precompute_rays", "--cfg_path", "cfg/x.yml"],
                    [sys.executable, "-m", "nerfjax_torch.cli.train", "--cfg_path", "cfg/x.yml"]]
    every = logic.build_pipeline_commands("c.json", [True] * len(logic.PIPELINE_STEPS))
    theirs = jax_logic.build_pipeline_commands("c.json", [True] * len(logic.PIPELINE_STEPS))
    assert [c[:2] + c[3:] for c in every] == [c[:2] + c[3:] for c in theirs]


def _dense_volume():
    occ = np.zeros((5, 5, 5), np.uint8)
    occ[2, 2, 2] = 1
    occ[0, 4, 1] = 1
    rgbv = np.zeros((5, 5, 5, 3), np.uint8)
    rgbv[2, 2, 2] = [255, 0, 0]
    rgbv[0, 4, 1] = [10, 200, 30]
    return {"occupancy_volume": occ, "rgb_volume": rgbv, "metadata": {}}


def _sliced_volume():
    return {
        "points_normalized": np.array([[0.5, 0, 0], [-0.25, 0.5, 0.75]], np.float32),
        "rgbs": np.array([[255.0, 128.0, 0.0], [3.0, 4.0, 5.0]], np.float32),
        "aabb_meta": {"aabb_remove_below": -0.5, "aabb_remove_above": 0.5},
    }


@pytest.mark.parametrize("writer", ["nerfjax", "port"])
def test_load_volume_any_both_formats(tmp_path, writer):
    save = pth.save if writer == "nerfjax" else ckpt.save_pth
    for name, vol in (("volume.pth", _dense_volume()), ("volume_sliced.pth", _sliced_volume())):
        p = tmp_path / name
        save(vol, p)
        pts, rgbs, aabb = logic.load_volume_any(p)
        want = jax_logic.load_volume_any(p)
        np.testing.assert_array_equal(pts, want[0])
        np.testing.assert_array_equal(rgbs, want[1])
        assert pts.dtype == want[0].dtype == np.float32 and rgbs.dtype == want[1].dtype
        assert aabb == want[2]
    pts, _, aabb = logic.load_volume_any(tmp_path / "volume.pth")
    assert pts.shape == (2, 3) and aabb is None
    _, rgbs, aabb = logic.load_volume_any(tmp_path / "volume_sliced.pth")
    assert rgbs.max() <= 1.0 and aabb["aabb_remove_below"] == -0.5
    bad = tmp_path / "other.pth"
    save({"something": np.zeros(3, np.float32)}, bad)
    with pytest.raises(ValueError, match="Unrecognized volume file format"):
        logic.load_volume_any(bad)


def test_load_volume_any_sparse_fetch_normalizer(tmp_path):
    occ = np.zeros((4, 4, 4), np.uint8)
    occ[1, 1, 1] = 1
    rgbv = np.zeros((4, 4, 4, 3), np.float32)
    rgbv[1, 1, 1] = [0.5, 0.25, 0.0]  # occupied max = 0.5, global max = 2.0
    p = tmp_path / "volume.pth"
    ckpt.save_pth({"occupancy_volume": occ, "rgb_volume": rgbv, "metadata": {"rgb_global_max": 2.0}}, p)
    _, rgbs, _ = logic.load_volume_any(p)
    np.testing.assert_array_equal(rgbs, jax_logic.load_volume_any(p)[1])
    np.testing.assert_allclose(rgbs[0], [0.25, 0.125, 0.0], atol=1e-6)


def test_slice_and_clip():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    for got, want in ((logic.slice_z(pts, rgbs, -0.5, 0.5), jax_logic.slice_z(pts, rgbs, -0.5, 0.5)),
                      (logic.clip_aabb_band(pts, rgbs, {"aabb_remove_below": -1.0, "aabb_remove_above": 0.1}),
                       jax_logic.clip_aabb_band(pts, rgbs, {"aabb_remove_below": -1.0, "aabb_remove_above": 0.1})),
                      (logic.clip_aabb_band(pts, rgbs, {}), jax_logic.clip_aabb_band(pts, rgbs, {}))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    s, _ = logic.slice_z(np.array([[0, 0, -0.9], [0, 0, 0.0], [0, 0, 0.9]], np.float32), np.eye(3), -0.5, 0.5)
    assert len(s) == 1


def test_gui_classes_construct_headless():
    """The GUI modules import without a display and without tkinter at module
    level; widgets are built only where a display is available."""
    fg = importlib.import_module("nerfjax_torch.gui.final_gui")
    rg = importlib.import_module("nerfjax_torch.gui.run_gui")
    og = importlib.import_module("nerfjax_torch.gui.open3d_gui")
    assert hasattr(fg, "FinalGui") and hasattr(fg, "main")
    assert hasattr(rg, "PointCloudMinimalGui") and hasattr(rg, "main")
    assert hasattr(og, "PointCloudMinimalGUI") and hasattr(og, "main") and hasattr(og, "_render_proc")
    for mod in (fg, rg, og):
        assert "tkinter" not in vars(mod) and "matplotlib" not in vars(mod)
    if os.environ.get("DISPLAY"):
        gui = fg.FinalGui()
        assert len(gui.step_vars) == len(logic.PIPELINE_STEPS)
        gui.root.destroy()


def test_aabb_band_from_transforms(tmp_path):
    p = tmp_path / "transforms_s.json"
    p.write_text(json.dumps({"scene_aabb": {"aabb_remove_below": -0.25, "aabb_remove_above": 0.75,
                                            "aabb_min": [-1, -1, -0.25], "aabb_max": [1, 1, 0.85]}}))
    band = logic.aabb_band_from_transforms(p)
    assert band == jax_logic.aabb_band_from_transforms(p)
    empty = tmp_path / "transforms_e.json"
    empty.write_text(json.dumps({"frames": []}))
    assert logic.aabb_band_from_transforms(empty) == jax_logic.aabb_band_from_transforms(empty)
    pts = np.array([[0, 0, -0.5], [0, 0, 0.0], [0, 0, 0.9]], np.float32)
    out_pts, _ = logic.clip_aabb_band(pts, np.ones_like(pts), band)
    assert len(out_pts) == 1 and out_pts[0, 2] == 0.0


def test_creator_fields_cover_full_schema():
    from nerfjax.gui.final_gui import _CONFIG_FIELDS as JAX_FIELDS
    from nerfjax_torch.gui.final_gui import _CONFIG_FIELDS

    assert _CONFIG_FIELDS == JAX_FIELDS
    surfaced = {k for k, _, _ in _CONFIG_FIELDS}
    cfg = logic.generate_config_dict({k: d for k, d, _ in _CONFIG_FIELDS})
    assert cfg == jax_logic.generate_config_dict({k: d for k, d, _ in _CONFIG_FIELDS})
    flat_inputs = set()
    for key in cfg:
        if key == "percentile_bbox":
            flat_inputs |= {"pb_lower", "pb_upper", "pb_padding"}
        elif key == "aabb_adjust":
            flat_inputs |= {"aabb_adjust_min", "aabb_adjust_max"}
        elif key != "rotation_initial":
            flat_inputs.add(key)
    assert not flat_inputs - surfaced
    assert len(surfaced) >= 45


def test_standalone_viewers_import():
    import nerfjax_torch.gui.open3d_gui as og
    import nerfjax_torch.gui.run_gui as rg

    assert og.load_volume_any is logic.load_volume_any
    assert rg.load_volume_any is logic.load_volume_any


def test_launcher_loop_logs_as_nerfjax(tmp_path):
    """logic.run_commands on small commands, the third of which exits 1:
    its log lines equal those of nerfjax's FinalGui._run_commands, and
    the command after the failing one never runs."""
    from nerfjax.gui.final_gui import FinalGui as JaxGui
    from nerfjax_torch.gui.final_gui import FinalGui

    marker = tmp_path / "ran"
    cmds = [
        [sys.executable, "-c", "print('step one'); print('second line')"],
        [sys.executable, "-c", "import sys; print('to stdout'); print('to stderr', file=sys.stderr)"],
        [sys.executable, "-c", "import sys; print('failing'); sys.exit(1)"],
        [sys.executable, "-c", f"open({str(marker)!r}, 'w').write('x')"],
    ]

    class Stand:  # a stand-in self: the loop uses only _log
        def __init__(self):
            self.lines = []

        def _log(self, msg):
            self.lines.append(msg)

    theirs = Stand()
    JaxGui._run_commands(theirs, cmds)
    mine = []
    assert logic.run_commands(cmds, mine.append) is False
    assert mine == theirs.lines
    assert not marker.exists()
    assert mine[-1] == "Step FAILED (exit 1); stopping chain."
    assert "to stderr" in mine and "second line" in mine

    through_method = Stand()
    FinalGui._run_commands(through_method, cmds[:2])
    reference = Stand()
    JaxGui._run_commands(reference, cmds[:2])
    assert through_method.lines == reference.lines
    assert through_method.lines[-1] == "All selected steps completed."
