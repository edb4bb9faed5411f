"""chip_smoke.py's quality phase runs nerfjax's own protocol
(benchmarks/psnr_parity.py): its copies of the spass2, spass8 and tuned
(``spass12Led1k1f1scns24gl2sg32``) cfgs equal ``_cfg``'s on every key the
port reads, its eval is nerfjax's ``_eval_psnr`` (``render_rays`` with its
constants, all the held-out rays in one call), and its eval constants and
the nerfjax PSNRs it prints beside the port's equal the benchmark's and
``benchmarks/psnr_parity.json``'s rows. The benchmark is imported here
only: chip_smoke.py and the port import nothing of nerfjax."""

import importlib.util
import inspect
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARMS = ("spass2", "spass8", "spass12Led1k1f1scns24gl2sg32")
# keys whose values are paths or names of the run, not of the protocol
PATH_KEYS = {"scene_name", "rays_file", "output_dir", "checkpoint_dir", "checkpoint", "transforms_json", "colmap_dir",
             "tmp_image_dir"}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def parity():
    return _load("psnr_parity", ROOT / "benchmarks" / "psnr_parity.py")


def _port_cfg_keys() -> set[str]:
    """Every cfg key that a module of the port reads (``cfg.get("k"`` or
    ``cfg["k"]``)."""
    keys = set()
    for path in (ROOT / "nerfjax_torch").rglob("*.py"):
        keys |= set(re.findall(r"cfg(?:\.get\(|\[)\"([A-Za-z_0-9]+)\"", path.read_text()))
    return keys


def test_the_port_reads_the_protocols_keys():
    keys = _port_cfg_keys()
    assert {"hash_grad_corners", "single_pass", "occ_segments", "nerf_type", "batch_size", "num_epochs",
            "N_samples", "N_importance", "precision", "occupancy_grid", "rays_file"} <= keys


@pytest.mark.parametrize("arm", ARMS)
def test_cfg_copy_equals_psnr_parity_cfg(arm, smoke, parity, tmp_path):
    rays = tmp_path / "rays.npz"
    ours = smoke.parity_cfg(arm, rays, tmp_path / "out")
    nerf_type, batch = smoke.PARITY_ARMS[arm]
    ref = parity._cfg("tag", arm, batch, smoke.PARITY_STEPS, rays, nerf_type=nerf_type)
    keys = _port_cfg_keys() - PATH_KEYS
    assert {k: ours.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    assert ours["rays_file"] == ref["rays_file"] == str(rays)
    assert ours["hash_grad_corners"] == {"spass2": 2, "spass8": 8, smoke.PARITY_TUNED_ARM: 1}[arm]
    assert (nerf_type, batch) == (("large", 8192) if arm == smoke.PARITY_TUNED_ARM else ("medium", smoke.PARITY_BATCH))


def test_tuned_arm_has_the_tuned_cfgs_estimators(smoke, tmp_path):
    """The tuned arm trains cfg/blender_scene_tuned.yml's model and
    estimators at the protocol's batch and steps."""
    import yaml

    tuned = yaml.safe_load((ROOT / "cfg" / "blender_scene_tuned.yml").read_text())
    ours = smoke.parity_cfg(smoke.PARITY_TUNED_ARM, tmp_path / "rays.npz", tmp_path / "out")
    keys = ("nerf_type", "N_samples", "N_importance", "single_pass", "occupancy_grid", "hash_n_levels",
            "hash_extra_dense_levels", "hash_grad_corners", "hash_fwd_corners", "hash_grad_levels", "occ_fast_cdf",
            "occ_segments", "batch_size")
    assert {k: ours[k] for k in keys} == {k: tuned[k] for k in keys}


def test_eval_constants_equal_the_benchmarks(smoke, parity):
    assert smoke.PARITY_EVAL_RAYS == parity.EVAL_RAYS == 4096
    assert smoke.PARITY_EVAL_SEED == parity.EVAL_SEED == 9999
    assert smoke.PARITY_STEPS_PER_EPOCH == parity.STEPS_PER_EPOCH
    ns, ni = smoke.PARITY_EVAL_SAMPLES
    assert f"n_samples={ns}, n_importance={ni}," in inspect.getsource(parity._eval_psnr)
    assert "scene=scene" in inspect.getsource(parity._eval_psnr)
    assert "batch * STEPS_PER_EPOCH" in inspect.getsource(parity.run_one)


@pytest.mark.parametrize("arm", ARMS)
def test_recorded_psnrs_equal_psnr_parity_json(arm, smoke):
    rows = json.loads((ROOT / "benchmarks" / "psnr_parity.json").read_text())
    nerf_type, batch = smoke.PARITY_ARMS[arm]
    got = {r["seed"]: r["eval_psnr"] for r in rows
           if r["scene"] == "sphere" and r["arm"] == arm and (r.get("nerf_type") or "medium") == nerf_type
           and r.get("batch", 2048) == batch and r["steps"] == smoke.PARITY_STEPS
           and not r.get("photometric")}
    assert got == dict(zip(smoke.PARITY_SEEDS, smoke.PARITY_NERFJAX_DB[arm]))
    assert set(smoke.PARITY_NERFJAX_DB) == set(ARMS) == set(smoke.PARITY_ARMS)


def test_eval_is_render_rays_with_psnr_parity_constants(smoke, parity, monkeypatch, tmp_path):
    """_parity_eval_psnr renders as nerfjax's _eval_psnr: render_rays (the
    point-major path) on all the held-out rays in one call, 64 + 128,
    train=False, the checkpoint's field in f32 for both passes, draws from
    a generator of seed 0; its PSNR is -10 log10 of the MSE against the
    rays' rgbs. Run on the CPU at a small spec."""
    import numpy as np
    import torch

    from nerfjax_torch import render
    from nerfjax_torch.checkpoint import save_field_params
    from nerfjax_torch.train import build_fields

    syn = _load("synthetic", ROOT / "tests" / "synthetic.py")
    data = syn.make_ray_npz(tmp_path / "eval.npz", n_rays=32, seed=smoke.PARITY_EVAL_SEED, scene="sphere")
    cfg = {"ngp": True, "nerf_type": "small", "hash_n_levels": 6, "precision": "bf16"}
    field = build_fields(cfg)[1].init(torch.Generator().manual_seed(0))
    save_field_params(tmp_path / "ckpt.pth", cfg, {k: v for k, v in field.params().items()})
    calls, real = [], render.render_rays

    def spy(fc, ff, ro, rd, tn, tf, n_samples, n_importance, **kw):
        out = real(fc, ff, ro, rd, tn, tf, n_samples, n_importance, **kw)
        calls.append({"same_field": fc is ff, "dtype": ff.table.dtype, "rays": ro.shape[0], "n": (n_samples, n_importance),
                      "train": kw.get("train"), "seed": kw["generator"].initial_seed(), "rgb": out["rgb_fine"]})
        return out

    monkeypatch.setattr(render, "render_rays", spy)
    got = smoke._parity_eval_psnr(tmp_path / "ckpt.pth", cfg, data, device="cpu")
    (call,) = calls
    assert call["n"] == smoke.PARITY_EVAL_SAMPLES == (64, 128)
    assert f"n_samples={call['n'][0]}, n_importance={call['n'][1]}," in inspect.getsource(parity._eval_psnr)
    assert "jax.random.PRNGKey(0)" in inspect.getsource(parity._eval_psnr)
    assert call["rays"] == 32 and call["train"] is False and call["seed"] == 0 and call["same_field"]
    assert call["dtype"] == torch.float32
    mse = float(np.mean((call["rgb"].numpy() - data["rgbs"]) ** 2))
    assert got["psnr"] == pytest.approx(-10.0 * np.log10(mse), rel=1e-12)
    assert np.isfinite(got["planar_psnr"]) and got["planar_psnr"] != got["psnr"]
