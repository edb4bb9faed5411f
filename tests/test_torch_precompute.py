"""nerfjax_torch's ray precompute on the CPU against nerfjax's: a transforms
JSON and three 24 x 32 PNG frames written by tests/synthetic.py, the same
arrays (equal masks and colors; rays and t within 1e-6), the NPZ read back
by nerfjax, and the CLI on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nerfjax.rays import load_ray_data as jax_load_ray_data
from nerfjax.rays import precompute_rays_for_scene as jax_precompute
from nerfjax_torch import rays as R
from tests.synthetic import make_image_scene

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("rays_o", "rays_d", "rgbs", "t_near", "t_far")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    return make_image_scene(d, "t", n_frames=3, H=24, W=32)


def _close(got: dict, want: dict) -> None:
    assert got["rays_o"].shape == want["rays_o"].shape  # the same rays kept
    np.testing.assert_array_equal(got["rgbs"], want["rgbs"])
    for k in ("rays_o", "rays_d", "t_near", "t_far"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_precompute_matches_nerfjax(scene):
    want = jax_precompute(scene)
    got = R.precompute_rays_for_scene(scene, device="cpu")
    assert set(got) == set(KEYS)
    assert 0 < len(got["rays_o"]) < 3 * 24 * 32  # some rays miss the cube
    _close(got, want)


def test_precompute_keeps_the_hits_of_get_rays(scene):
    """The kept rays are get_rays' rays whose intersection hits, in frame
    and pixel order, with the decoded colors."""
    import json

    import torch
    from PIL import Image

    meta = json.loads(Path(scene).read_text())
    poses = np.array([f["transform_matrix"] for f in meta["frames"]], np.float32)
    o, d = R.get_rays(24, 32, meta["K"], torch.from_numpy(poses))
    hit, tn, tf = R.ray_cube_intersection(o.reshape(-1, 3), d.reshape(-1, 3))
    rgb = np.concatenate([np.asarray(Image.open(f["file_path"]).convert("RGB"), np.float32).reshape(-1, 3) / 255.0
                          for f in meta["frames"]])
    got = R.precompute_rays_for_scene(scene, device="cpu")
    m = hit.numpy()
    assert 0 < m.sum() < m.size
    for k, want in (("rays_o", o.reshape(-1, 3)[hit]), ("rays_d", d.reshape(-1, 3)[hit]), ("t_near", tn[hit]),
                    ("t_far", tf[hit]), ("rgbs", rgb[m])):
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)


@pytest.mark.parametrize("batch_frames", [1, 2])
def test_batch_frames_leave_the_arrays_unchanged(scene, batch_frames):
    a = R.precompute_rays_for_scene(scene, batch_frames=batch_frames, device="cpu")
    b = R.precompute_rays_for_scene(scene, batch_frames=16, device="cpu")
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k])


def test_image_loader_and_stats(scene):
    """A custom image_loader supplies the colors; stats holds each stage's
    seconds and the rays generated and kept."""
    stats = {}
    got = R.precompute_rays_for_scene(scene, image_loader=lambda p: np.full((24, 32, 3), 0.25, np.float32),
                                      device="cpu", stats=stats)
    assert (got["rgbs"] == 0.25).all()
    assert stats["generated"] == 3 * 24 * 32 and stats["kept"] == len(got["rays_o"])
    assert all(stats[k] >= 0.0 for k in ("decode", "rays", "compact_fetch"))


def test_npz_loads_in_nerfjax(scene, tmp_path):
    data = R.precompute_rays_for_scene(scene, device="cpu")
    path = tmp_path / "sub" / "t_ray_data.npz"
    R.save_ray_data(data, path)
    back = jax_load_ray_data(path)
    assert set(back) == set(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(back[k], data[k])


def _cli(cfg_lines: list[str], cwd: Path, *extra: str) -> subprocess.CompletedProcess:
    (cwd / "cfg.yml").write_text("\n".join(cfg_lines) + "\n")
    return subprocess.run([sys.executable, "-m", "nerfjax_torch.cli.precompute_rays", "--cfg_path",
                           str(cwd / "cfg.yml"), *extra], capture_output=True, text=True, cwd=cwd, timeout=300,
                          env={**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])})


def test_cli_honours_transforms_json_and_rays_file(scene, tmp_path):
    out = tmp_path / "out" / "rays.npz"
    res = _cli([f"transforms_json: {scene}", f"rays_file: {out}"], tmp_path, "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert f"Saved rays data to {out}." in res.stdout and "Stages: " in res.stdout.splitlines()[-1]
    _close(jax_load_ray_data(out), jax_precompute(scene))


def test_cli_defaults_to_the_scene_names(scene, tmp_path):
    """Without transforms_json and rays_file the CLI reads
    transforms_<scene_name>.json and writes <scene_name>_ray_data.npz in
    the working directory, as nerfjax's does."""
    (tmp_path / "transforms_t.json").write_text(Path(scene).read_text())
    res = _cli(["scene_name: t"], tmp_path, "--device", "cpu")
    assert res.returncode == 0, res.stderr
    _close(jax_load_ray_data(tmp_path / "t_ray_data.npz"), jax_precompute(scene))


def test_default_device_needs_a_card(scene, tmp_path, monkeypatch):
    import torch

    from nerfjax_torch.cli import precompute_rays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        R.precompute_rays_for_scene(scene)
    (tmp_path / "cfg.yml").write_text(f"transforms_json: {scene}\nrays_file: {tmp_path / 'r.npz'}\n")
    monkeypatch.setattr(sys, "argv", ["precompute_rays", "--cfg_path", str(tmp_path / "cfg.yml")])
    with pytest.raises(RuntimeError, match="cuda"):
        precompute_rays.main()
    assert not (tmp_path / "r.npz").exists()
