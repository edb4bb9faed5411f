"""The port stands alone: nothing under nerfjax_torch/, and not chip_smoke.py,
imports nerfjax or jax; the modules it copied from nerfjax stay equal to
theirs; and the .pth files of the two packages read each other's."""

import ast
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nerfjax import pth
from nerfjax.checkpoint import load_field_params as jax_load_field_params
from nerfjax.checkpoint import load_occ_grid as jax_load_occ_grid
from nerfjax.config import load_config as jax_load_config
from nerfjax.config import with_defaults as jax_with_defaults
from nerfjax.extract import load_volume as jax_load_volume
from nerfjax.gui import viewers as jax_viewers
from nerfjax.postprocess import volume_to_points as jax_volume_to_points
from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch.config import load_config, with_defaults
from nerfjax_torch.extract import load_volume, save_volume
from nerfjax_torch.gui import viewers
from nerfjax_torch.postprocess import volume_to_points

ROOT = Path(__file__).resolve().parents[1]
# the package's sources (not the gitignored build directory) and the smoke script
PORT_FILES = sorted(p for p in (ROOT / "nerfjax_torch").rglob("*.py") if "_build" not in p.parts) + [
    ROOT / "chip_smoke.py"]
SMALL = {"ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1}


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_nerfjax_nor_jax(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("nerfjax", "jax", "jaxlib", "flax", "optax"), f"{path.name} imports {name}"


def test_every_port_module_imports_without_nerfjax_and_jax():
    """In a fresh interpreter where importing nerfjax or jax fails."""
    code = (
        "import sys, importlib, pkgutil, importlib.util\n"
        "for m in ('nerfjax', 'jax', 'jaxlib'): sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import nerfjax_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(nerfjax_torch.__path__, 'nerfjax_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(' '.join(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert len(mods) >= 24
    for name in ("render", "render_image", "rays", "probes", "cli.render", "cli.eval_psnr"):
        assert f"nerfjax_torch.{name}" in mods


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "cfg").glob("*.yml")))
def test_config_copy_matches_nerfjax(name):
    path = ROOT / "cfg" / name
    assert with_defaults(load_config(path)).to_dict() == jax_with_defaults(jax_load_config(path)).to_dict()


def test_volume_to_points_copy_matches_nerfjax():
    rng = np.random.default_rng(0)
    for shape in ((16, 16, 16), (12, 10, 9)):
        occ = (rng.uniform(size=shape) < 0.2).astype(np.uint8)
        rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        for gmax in (None, 300.0):
            for a, b in zip(volume_to_points(occ, rgb, gmax), jax_volume_to_points(occ, rgb, gmax)):
                np.testing.assert_array_equal(a, b)
    pts = rng.normal(size=(1000, 3))
    for a, b in zip(viewers._subsample(pts, pts, 100), jax_viewers._subsample(pts, pts, 100)):
        np.testing.assert_array_equal(a, b)


def test_nerfjax_pth_file_loads_in_the_port(tmp_path):
    """Tuples, ints, floats, strings, nested dicts and arrays of several
    dtypes written by nerfjax.pth (with a side-band record) come back equal,
    with the same dtypes, through torch.load(weights_only=True)."""
    arrays = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4), "u8": np.arange(5, dtype=np.uint8),
              "i64": np.array([-3, 7], np.int64), "f16": np.ones(3, np.float16), "b": np.array([True, False])}
    obj = {"iteration": 4, "lr": 5e-4, "name": "x", "betas": (0.9, 0.999), "state": {0: {"step": 3, **arrays}},
           "empty": np.zeros((0,), np.float32)}
    grid = np.random.default_rng(1).uniform(size=4096).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, grid)
    pth.save(obj, tmp_path / "a.pth", extra_records={"occ_grid.npy": buf.getvalue(), "blob": b"abc"})
    back = ckpt.load_pth(tmp_path / "a.pth")
    assert back["iteration"] == 4 and back["lr"] == 5e-4 and back["name"] == "x" and back["betas"] == (0.9, 0.999)
    for k, a in arrays.items():
        assert back["state"][0][k].dtype == a.dtype
        np.testing.assert_array_equal(back["state"][0][k], a)
    assert back["empty"].shape == (0,)
    assert ckpt.load_extra_record(tmp_path / "a.pth", "blob") == b"abc"
    assert ckpt.load_extra_record(tmp_path / "a.pth", "missing") is None
    np.testing.assert_array_equal(ckpt.load_occ_grid(tmp_path / "a.pth"), grid)


def test_nerfjax_checkpoint_loads_in_the_port(tmp_path):
    from nerfjax.checkpoint import ngp_to_state_dict
    from nerfjax.config import ConfigNode
    from nerfjax.train import build_fields, init_params

    import jax

    params = init_params(ConfigNode(SMALL), jax.random.PRNGKey(0))
    sd = ngp_to_state_dict(build_fields(ConfigNode(SMALL))[1], jax.device_get(params["model"]))
    pth.save({"iteration": 1, "nerf_coarse_state_dict": sd, "nerf_fine_state_dict": sd}, tmp_path / "c.pth")
    got = ckpt.load_field_params(tmp_path / "c.pth", SMALL)["model"]
    want = ckpt.params_to_numpy(ckpt.params_from_jax(params["model"]))
    np.testing.assert_array_equal(got["table"].numpy(), want["table"])
    for name in ("dmlp", "cmlp"):
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a["w"].numpy(), b["w"])


def test_port_volume_loads_in_nerfjax(tmp_path):
    rng = np.random.default_rng(2)
    vol = {"occupancy_volume": (rng.uniform(size=(8, 8, 8)) < 0.3).astype(np.uint8),
           "rgb_volume": rng.integers(0, 256, (8, 8, 8, 3), dtype=np.uint8),
           "metadata": {"resolution": 8, "bounds": [-1.0, 1.0], "threshold": 0.5, "sparse_fetch": True,
                        "phase_seconds": {"fine": 0.1}, "timestamp": "t"}}
    save_volume(vol, tmp_path / "volume.pth")
    for back in (jax_load_volume(tmp_path / "volume.pth"), pth.load(tmp_path / "volume.pth"),
                 load_volume(tmp_path / "volume.pth")):
        assert back.keys() == vol.keys()
        for k in ("occupancy_volume", "rgb_volume"):
            assert back[k].dtype == np.uint8
            np.testing.assert_array_equal(back[k], vol[k])
        assert json.dumps(back["metadata"], sort_keys=True) == json.dumps(vol["metadata"], sort_keys=True)


def test_port_train_checkpoint_loads_in_nerfjax(tmp_path):
    """A checkpoint of save_train_state (state dicts, optimizer summary,
    occ_grid.npy record) reads back in nerfjax with the same tensors."""
    import torch

    from nerfjax_torch.train import TrainSettings, make_train_state

    cfg = {**SMALL, "single_pass": True, "occupancy_grid": True, "occ_fast_cdf": True, "occ_resolution": 16}
    state = make_train_state(cfg, TrainSettings.from_cfg(cfg, 10), device="cpu", seed=3)
    state.occ_grid = torch.rand(16**3, generator=torch.Generator().manual_seed(0))
    ckpt.save_train_state(tmp_path / "n.pth", cfg, state.field, state.optimizer, 2, occ_grid=state.occ_grid)
    raw = pth.load(tmp_path / "n.pth")
    assert set(raw) == {"iteration", "nerf_coarse_state_dict", "nerf_fine_state_dict", "optimizer_state_dict"}
    assert raw["iteration"] == 2
    for key, value in raw["nerf_fine_state_dict"].items():
        assert value.dtype == np.float32, key
    from nerfjax.config import ConfigNode

    got = jax_load_field_params(tmp_path / "n.pth", ConfigNode(cfg))["model"]
    want = ckpt.params_to_numpy(state.field.params())
    np.testing.assert_array_equal(np.asarray(got["table"]), want["table"])
    for name in ("dmlp", "cmlp"):
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(np.asarray(a["w"]), b["w"])
    np.testing.assert_array_equal(jax_load_occ_grid(tmp_path / "n.pth"), state.occ_grid.numpy())
