"""chip_smoke.py's quality phase runs nerfjax's own protocol
(benchmarks/psnr_parity.py): its copies of the spass2 and spass8 cfgs equal
``_cfg``'s on every key the port reads, and its eval constants and the
nerfjax PSNRs it prints beside the port's equal the benchmark's and
``benchmarks/psnr_parity.json``'s rows. The benchmark is imported here
only: chip_smoke.py and the port import nothing of nerfjax."""

import importlib.util
import inspect
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARMS = ("spass2", "spass8")
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
    ref = parity._cfg("tag", arm, smoke.PARITY_BATCH, smoke.PARITY_STEPS, rays, nerf_type="medium")
    keys = _port_cfg_keys() - PATH_KEYS
    assert {k: ours.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    assert ours["rays_file"] == ref["rays_file"] == str(rays)
    assert ours["hash_grad_corners"] == {"spass2": 2, "spass8": 8}[arm]


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
    got = {r["seed"]: r["eval_psnr"] for r in rows
           if r["scene"] == "sphere" and r["arm"] == arm and (r.get("nerf_type") or "medium") == "medium"
           and r.get("batch", 2048) == smoke.PARITY_BATCH and r["steps"] == smoke.PARITY_STEPS
           and not r.get("photometric")}
    assert got == dict(zip(smoke.PARITY_SEEDS, smoke.PARITY_NERFJAX_DB[arm]))
