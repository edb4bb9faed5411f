"""The chain's tail in nerfjax_torch (volume.pth -> volume_sliced.pth ->
napari/paraview tiffs and VTI) against nerfjax's, on the same synthetic
volume: the files byte-equal, the .pth files read by the other package, the
copied writers equal to nerfjax's, and both CLIs on the CPU.

nerfjax voxelizes with its C++ kernel when its native library loads (it
builds with g++ on first use) and with numpy otherwise; the two differ in
the scale's rounding, the colour clamp and which of several points in a
voxel wins. The port reproduces the C++ path; the tests assert that
nerfjax took it.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nerfjax import native, pth
from nerfjax import postprocess as jpp
from nerfjax.config import ConfigNode as JaxConfigNode
from nerfjax.formats import tiff as jtiff
from nerfjax.formats import vti as jvti
from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch import postprocess as pp
from nerfjax_torch.config import ConfigNode
from nerfjax_torch.extract import save_volume
from nerfjax_torch.formats import tiff, vti
from tests.test_torch_native_ref import nerfjax_native

ROOT = Path(__file__).resolve().parents[1]
FILES = ["napari/volume_sliced_binary.tif", "napari/volume_sliced_rgb.tif", "paraview/volume_sliced_binary.tiff",
         "paraview/volume_sliced_rgb.tiff", "vti/volume_sliced_binary.vti", "vti/volume_sliced_rgb.vti"]


@pytest.fixture(scope="module", autouse=True)
def _nerfjax_native_loaded():
    """nerfjax's voxelizer below takes its native path."""
    nerfjax_native()


def _nerfjax_voxelizes_natively() -> bool:
    return nerfjax_native() is not None and native.load() is not None


def _scene(tmp_path: Path, res: int = 32, seed: int = 0) -> dict:
    """A seeded res^3 volume.pth (written by the port) whose metadata
    records an rgb_global_max of 100 while its colours reach 255 (so the
    sliced points carry colours up to 2.55), a transforms JSON with a
    scene_aabb inside [-1, 1]^3, and the cfg keys of the tail."""
    rng = np.random.default_rng(seed)
    occ = (rng.uniform(size=(res,) * 3) < 0.3).astype(np.uint8)
    rgb = rng.integers(0, 256, (res,) * 3 + (3,), dtype=np.uint8)
    save_volume({"occupancy_volume": occ, "rgb_volume": rgb,
                 "metadata": {"resolution": res, "rgb_global_max": 100.0}}, tmp_path / "volume.pth")
    aabb = {"aabb_min": [-0.8, -0.9, -0.7], "aabb_max": [0.85, 0.6, 0.9]}
    (tmp_path / "transforms.json").write_text(json.dumps({"frames": [], "scene_aabb": aabb}))
    return {"volume_output_path": str(tmp_path / "volume.pth"), "transforms_json": str(tmp_path / "transforms.json"),
            "aabb_slice": True}


def _cfgs(tmp_path: Path, keys: dict):
    """(nerfjax cfg, port cfg): the same volume and transforms, each its own
    output directory and sliced path."""
    out = []
    for name, node in (("jax", JaxConfigNode), ("port", ConfigNode)):
        d = tmp_path / name
        d.mkdir()
        out.append(node({**keys, "output_dir": str(d), "sliced_vol_path": str(d / "volume_sliced.pth")}))
    return out


def test_voxelize_matches_nerfjax_native_path():
    """Points in and just outside [-1, 1], several per voxel with other
    colours (the last point's wins), colours above 1 and below 0 (clamped
    to 255 and 0), at grid sizes 8, 17 and 64."""
    assert _nerfjax_voxelizes_natively(), "nerfjax's native voxelizer did not load: the parity target is its C++ path"
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.05, 1.05, (20_000, 3)).astype(np.float32)
    pts[:4] = [[-1, -1, -1], [1, 1, 1], [1, 1, 1], [0.0, -0.0, 1e-8]]
    rgbs = rng.uniform(-0.3, 2.6, (20_000, 3)).astype(np.float32)
    for g in (8, 17, 64):
        got = pp.voxelize_points(pts, rgbs, g)
        ref = jpp.voxelize_points(pts, rgbs, g)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    binary, rgb = pp.voxelize_points(pts[1:3], np.array([[0.2, 0.2, 0.2], [0.9, 3.0, -1.0]], np.float32), 4)
    assert binary[3, 3, 3] == 255 and list(rgb[3, 3, 3]) == [229, 255, 0]  # the later point, clamped


def test_tail_files_equal_nerfjax_byte_for_byte(tmp_path):
    """post_process then write_formats, nerfjax's and the port's, on one
    volume: volume_sliced.pth holds equal points, colours (some above 1)
    and AABB, and each package reads the other's; the six tif/tiff/vti
    files are byte-equal (grid 16 puts several points of other colours in
    one voxel)."""
    assert _nerfjax_voxelizes_natively()
    jcfg, tcfg = _cfgs(tmp_path, _scene(tmp_path))
    jres = jpp.post_process(jcfg, verbose=False)
    tres = pp.post_process(tcfg, verbose=False)
    for key in ("points", "rgbs"):
        np.testing.assert_array_equal(tres[key], jres[key])
    assert tres["aabb_meta"] == jres["aabb_meta"] and tres["rgbs"].max() > 1.0
    theirs, ours = pth.load(tcfg.sliced_vol_path), ckpt.load_pth(jcfg.sliced_vol_path)
    for a, b in ((theirs, ours), (ckpt.load_pth(tcfg.sliced_vol_path), pth.load(jcfg.sliced_vol_path))):
        for key in ("points_normalized", "rgbs"):
            assert np.asarray(a[key]).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
        assert a["aabb_meta"] == b["aabb_meta"]
    jvol = jpp.write_formats(jcfg, grid_size=16, verbose=False)
    tvol = pp.write_formats(tcfg, grid_size=16, verbose=False)
    np.testing.assert_array_equal(tvol["rgb_volume"], jvol["rgb_volume"])
    counts = np.unique(((tres["points"] + 1) * 7.5).astype(np.int64) @ np.array([256, 16, 1]), return_counts=True)[1]
    assert counts.max() > 1  # voxels hit twice
    for rel in FILES:
        assert (Path(tcfg.output_dir) / rel).read_bytes() == (Path(jcfg.output_dir) / rel).read_bytes(), rel


@pytest.mark.parametrize("shape", [(5, 7, 9), (4, 6, 3, 3), (1, 1, 1)])
def test_format_writers_copy_nerfjax(tmp_path, shape):
    """The port's tiff and vti writers write nerfjax's bytes (grey and RGB
    volumes); the readers read them back; slice_aabb keeps the same
    points."""
    vol = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    for ours, theirs, suffix in ((tiff.write_tiff_volume, jtiff.write_tiff_volume, "tif"),
                                 (vti.write_vti_volume, jvti.write_vti_volume, "vti")):
        ours(vol, tmp_path / f"port.{suffix}")
        theirs(vol, tmp_path / f"jax.{suffix}")
        assert (tmp_path / f"port.{suffix}").read_bytes() == (tmp_path / f"jax.{suffix}").read_bytes()
    np.testing.assert_array_equal(tiff.read_tiff_volume(tmp_path / "port.tif"), vol)
    want = np.transpose(vol.mean(-1).astype(np.uint8) if vol.ndim == 4 else vol, (2, 1, 0))
    np.testing.assert_array_equal(vti.read_vti_volume(tmp_path / "port.vti"), want)
    pts = np.random.default_rng(3).uniform(-1, 1, (500, 3)).astype(np.float32)
    meta = {"aabb_min": [-0.5, -0.2, -1.0], "aabb_max": [0.5, 1.0, 0.3]}
    for a, b in zip(pp.slice_aabb(pts, pts * 2, meta), jpp.slice_aabb(pts, pts * 2, meta)):
        np.testing.assert_array_equal(a, b)


def test_tail_clis_on_cpu(tmp_path):
    """python -m nerfjax_torch.cli.post_process_vol, then write_format, on a
    YAML cfg: volume_sliced.pth and the six files, equal to nerfjax's
    Python API's on the same volume."""
    keys = _scene(tmp_path, res=24, seed=4)
    jcfg, tcfg = _cfgs(tmp_path, keys)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(json.dumps({**keys, "output_dir": tcfg.output_dir, "sliced_vol_path": tcfg.sliced_vol_path}))
    for tool, extra in (("post_process_vol", []), ("write_format", ["--grid_size", "20"])):
        out = subprocess.run([sys.executable, "-m", f"nerfjax_torch.cli.{tool}", "--cfg_path", str(cfg_path), *extra],
                             cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
    jpp.post_process(jcfg, verbose=False)
    jpp.write_formats(jcfg, grid_size=20, verbose=False)
    for key in ("points_normalized", "rgbs"):
        np.testing.assert_array_equal(ckpt.load_pth(tcfg.sliced_vol_path)[key], pth.load(jcfg.sliced_vol_path)[key])
    for rel in FILES:
        assert (Path(tcfg.output_dir) / rel).read_bytes() == (Path(jcfg.output_dir) / rel).read_bytes(), rel
