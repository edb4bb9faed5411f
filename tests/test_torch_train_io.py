"""nerfjax_torch's training loop on the CPU at a tiny size: the checkpoints
it writes read back in nerfjax, it resumes from its own checkpoint exactly,
and its CLI trains and writes nerf_final.pth."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nerfjax.checkpoint import load_field_params as jax_load_field_params
from nerfjax.checkpoint import load_occ_grid as jax_load_occ_grid
from nerfjax.config import ConfigNode
from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch.train import train
from tests.synthetic import make_ray_npz

ROOT = Path(__file__).resolve().parents[1]
TINY = {
    "ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1,
    "batch_size": 128, "num_epochs": 3, "lr": 5e-3, "N_samples": 8, "N_importance": 16,
    "precision": "bf16", "occupancy_grid": True, "single_pass": True,
    "hash_grad_corners": 1, "hash_fwd_corners": 1, "hash_grad_levels": 2,
    "occ_resolution": 16, "occ_update_every": 2, "occ_update_partitions": 4,
    "occ_fast_cdf": True, "occ_segments": 8,
}


def _cfg(tmp_path: Path, **over) -> dict:
    tmp_path.mkdir(parents=True, exist_ok=True)
    rays = tmp_path / "rays.npz"
    if not rays.exists():
        make_ray_npz(rays, n_rays=256, seed=2)
    out = tmp_path / "out"
    return {**TINY, "rays_file": str(rays), "output_dir": str(out), "checkpoint_dir": str(out / "ckpt"), **over}


def _params_equal(a: dict, b: dict) -> None:
    np.testing.assert_array_equal(np.asarray(a["table"]), np.asarray(b["table"]))
    for name in ("dmlp", "cmlp"):
        for x, y in zip(a[name], b[name]):
            np.testing.assert_array_equal(np.asarray(x["w"]), np.asarray(y["w"]))


def test_final_checkpoint_loads_in_nerfjax(tmp_path):
    cfg = _cfg(tmp_path)
    out = train(cfg, device="cpu", log_every=1000)
    final = Path(cfg["checkpoint_dir"]) / "nerf_final.pth"
    assert out["steps"] == 6 and len(out["psnr"]) == 6 and np.isfinite(out["psnr"]).all()
    _params_equal(jax_load_field_params(final, ConfigNode(cfg))["model"], out["params"])
    grid = jax_load_occ_grid(final)
    assert grid.shape == (16**3,) and grid.dtype == np.float32
    np.testing.assert_array_equal(grid, ckpt.load_occ_grid(final))
    assert (Path(cfg["checkpoint_dir"]) / "nerf_epoch_000002.pth").exists()


def test_resume_continues_exactly(tmp_path):
    """Three epochs straight through, and the same run resumed from its
    epoch-2 checkpoint, end with equal parameters, moments and grid: the
    checkpoint holds the exact state and the step reseeds its draws."""
    a = _cfg(tmp_path / "a")
    ref = train(a, device="cpu", log_every=1000)
    b = _cfg(tmp_path / "b")
    Path(b["checkpoint_dir"]).mkdir(parents=True)
    epoch2 = Path(a["checkpoint_dir"]) / "nerf_epoch_000002.pth"
    (Path(b["checkpoint_dir"]) / epoch2.name).write_bytes(epoch2.read_bytes())
    got = train(b, device="cpu", resume=True, log_every=1000)
    assert got["steps"] == ref["steps"] == 6 and len(got["psnr"]) == 2
    _params_equal(got["params"], ref["params"])
    fa, fb = (ckpt.load_pth(Path(c["checkpoint_dir"]) / "nerf_final.pth") for c in (a, b))
    for i, s in fa["optimizer_state_dict"]["state"].items():
        t = fb["optimizer_state_dict"]["state"][i]
        assert s["step"] == t["step"] == 6
        np.testing.assert_array_equal(s["exp_avg"], t["exp_avg"])
        np.testing.assert_array_equal(s["exp_avg_sq"], t["exp_avg_sq"])
    np.testing.assert_array_equal(*(ckpt.load_occ_grid(Path(c["checkpoint_dir"]) / "nerf_final.pth") for c in (a, b)))


def test_cli_trains_on_cpu(tmp_path):
    cfg = _cfg(tmp_path, num_epochs=1, batch_size=128)
    lines = [f"{k}: {v}" for k, v in cfg.items()]
    (tmp_path / "cfg.yml").write_text("\n".join(lines) + "\n")
    res = subprocess.run(
        [sys.executable, "-m", "nerfjax_torch.cli.train", "--cfg_path", str(tmp_path / "cfg.yml"), "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "Total steps: 2" in res.stdout and "Training completed." in res.stdout
    assert (Path(cfg["checkpoint_dir"]) / "nerf_final.pth").exists()


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train(_cfg(tmp_path))


@pytest.mark.parametrize("over, error", [({"mesh_shape": [2, 1]}, ValueError),
                                         ({"ngp": False, "single_pass": True}, ValueError),
                                         ({"mesh_shape": [1, 2]}, ValueError)])
def test_unported_options_raise(tmp_path, over, error):
    """Options a run cannot take raise: a mesh that does not cover the world
    (here a world of one), and, like nerfjax, vanilla NeRF with
    single_pass: true."""
    with pytest.raises(error):
        train(_cfg(tmp_path, **over), device="cpu")
