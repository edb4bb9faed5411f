"""A cell, a configuration, a traffic mix and a per-layer metric are added
by new files and BENCHMARK.json entries alone: in a copy of the benchmark,
the harness runs the new cell and reads the new metric, no file edited."""

import json
import shutil
import subprocess
import sys

from pb_helpers import ROOT, SEED


def test_new_cell_and_metric_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "configs" / "ngp_small.json").write_text(json.dumps({
        "source": "https://arxiv.org/abs/2201.05989", "reduced": ["hash_n_levels", "train_rays"],
        "ngp": True, "nerf_type": "small", "hash_n_levels": 8, "batch_size": 64, "num_epochs": 1, "lr": 5e-4,
        "N_samples": 8, "N_importance": 16, "precision": "bf16", "occupancy_grid": False, "train_rays": 4096}))
    (pb / "workloads" / "ball_tiny.json").write_text(json.dumps({
        "kind": "train", "scene": {"cameras": 16, "camera_radius": 2.5, "aim": 0.8, "radius": 0.5, "sigma": 4.0,
                                   "rgb": [0.9, 0.6, 0.3], "center_range": 0.1},
        "field": {"radius": 0.5, "center_range": 0.1, "gain": 40.0},
        "warmup_steps": 3, "check_steps": 3, "log_every": 2, "trace_seconds": 0.2}))
    (pb / "limits" / "ngp_small.train.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}}))
    (pb / "metrics" / "steps_done.train.py").write_text("def read(run):\n    return run.units['steps']\n")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "ngp_small", "source": "https://arxiv.org/abs/2201.05989",
                                "file": "portbench/configs/ngp_small.json", "reduced": ["hash_n_levels", "train_rays"],
                                "why": "a test"})
    manifest["workloads"].append({"name": "ngp_small.train", "config": "ngp_small", "traffic": "ball_tiny",
                                  "chips": 1, "why": "a test"})
    next(m for m in manifest["end_to_end"] if m["name"] == "train_rays_per_s")["workloads"].append("ngp_small.train")
    manifest["per_layer"].append({"name": "steps_done.train", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "train loop and step",
                                  "moves": "train_rays_per_s", "workloads": ["ngp_small.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = (f"import io, json, sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "from portbench.harness import run_cell\n"
            f"a = run_cell('ngp_small.train', {SEED}, 0.2, False, device='cpu', stream=io.StringIO())\n"
            f"b = run_cell('ngp_small.train', {SEED}, 0.2, True, device='cpu', stream=io.StringIO())\n"
            "import portbench; print(json.dumps([a, b, portbench.__file__]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced, where = json.loads(out.stdout.strip().splitlines()[-1])
    assert where.startswith(str(tmp_path))
    assert set(plain["metrics"]) == {"train_rays_per_s", "setup_s"} and plain["correct"]
    assert traced["metrics"]["steps_done.train"]["value"] >= 1 and traced["metrics"]["steps_done.train"]["unit"] == "steps"
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there was edited
