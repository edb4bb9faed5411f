"""A cell, a configuration, a traffic mix, a per-layer metric and a kind of
traffic are added by new files and BENCHMARK.json entries alone: in a copy
of the benchmark, the harness runs the new cell and reads the new metric,
the suite collects the new kind's fault and control cases, and
``calibrate.py`` plans its faults, no file edited."""

import json
import os
import shutil
import subprocess
import sys

from pb_helpers import ROOT, SEED

NGP_SMALL = {"source": "https://arxiv.org/abs/2201.05989", "reduced": ["hash_n_levels", "train_rays"],
             "ngp": True, "nerf_type": "small", "hash_n_levels": 8, "batch_size": 64, "num_epochs": 1, "lr": 5e-4,
             "N_samples": 8, "N_importance": 16, "precision": "bf16", "occupancy_grid": False, "train_rays": 4096}
BALL_TINY = {"scene": {"cameras": 16, "camera_radius": 2.5, "aim": 0.8, "radius": 0.5, "sigma": 4.0,
                       "rgb": [0.9, 0.6, 0.3], "center_range": 0.1},
             "field": {"radius": 0.5, "center_range": 0.1, "gain": 40.0},
             "warmup_steps": 3, "check_steps": 3, "log_every": 2, "trace_seconds": 0.2}
TWIN_KIND = '''"""The training kind's set-up, window and check under another name, with
CPU sizes and a fault of its own."""

from portbench import faults
from portbench.harness import kind_module

_train = kind_module("train")
setup, window, check = _train.setup, _train.window, _train.check


def stepped_twice(patch):
    """AdamW steps twice a step: every leaf moves double."""
    from nerfjax_torch import train

    real = train.apply_gradients

    def twice(state):
        state.optimizer.step()
        real(state)

    patch(train, "apply_gradients", twice)


TINY = {"cfg": {"batch_size": 32}, "traffic": {"warmup_steps": 4}}
FAULTS = [faults.half_batch, stepped_twice]
'''


def _copy(tmp_path) -> dict:
    """Copies ``portbench/`` under ``tmp_path``; returns every file's bytes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    return {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}


def _add_cell(tmp_path, manifest: dict, cell: str, config: str, traffic: str, mix: dict, limits: dict) -> None:
    """A training cell of the mix ``traffic`` on ``config`` (NGP_SMALL): its files and its entries."""
    pb = tmp_path / "portbench"
    (pb / "configs" / f"{config}.json").write_text(json.dumps(NGP_SMALL))
    (pb / "workloads" / f"{traffic}.json").write_text(json.dumps(mix))
    (pb / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    manifest["configs"].append({"name": config, "source": NGP_SMALL["source"], "reduced": NGP_SMALL["reduced"],
                                "file": f"portbench/configs/{config}.json", "why": "a test"})
    manifest["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "a test"})
    next(m for m in manifest["end_to_end"] if m["name"] == "train_rays_per_s")["workloads"].append(cell)


def _python(tmp_path, *argv) -> str:
    """Runs ``python argv`` in the copy, the program found in the repo; returns its output."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_new_cell_and_metric_from_files_alone(tmp_path):
    before = _copy(tmp_path)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    _add_cell(tmp_path, manifest, "ngp_small.train", "ngp_small", "ball_tiny", {"kind": "train", **BALL_TINY},
              {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0})
    (tmp_path / "portbench" / "metrics" / "steps_done.train.py").write_text(
        "def read(run):\n    return run.units['steps']\n")
    manifest["per_layer"].append({"name": "steps_done.train", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "train loop and step",
                                  "moves": "train_rays_per_s", "workloads": ["ngp_small.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = (f"import io, json, sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "from portbench.harness import run_cell\n"
            f"a = run_cell('ngp_small.train', {SEED}, 0.2, False, device='cpu', stream=io.StringIO())\n"
            f"b = run_cell('ngp_small.train', {SEED}, 0.2, True, device='cpu', stream=io.StringIO())\n"
            "import portbench; print(json.dumps([a, b, portbench.__file__]))\n")
    plain, traced, where = json.loads(_python(tmp_path, "-c", code).strip().splitlines()[-1])
    assert where.startswith(str(tmp_path))
    assert set(plain["metrics"]) == {"train_rays_per_s", "setup_s"} and plain["correct"]
    assert traced["metrics"]["steps_done.train"]["value"] >= 1 and traced["metrics"]["steps_done.train"]["unit"] == "steps"
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there was edited


def test_new_kind_from_files_alone(tmp_path):
    before = _copy(tmp_path)
    (tmp_path / "portbench" / "kinds" / "train_twin.py").write_text(TWIN_KIND)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    limits = json.loads((ROOT / "portbench" / "limits" / "ngp_dropin.train.json").read_text())["limits"]
    cell = "ngp_twin.train"
    _add_cell(tmp_path, manifest, cell, "ngp_twin", "ball_twin", {"kind": "train_twin", **BALL_TINY}, limits)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = (f"import io, json, sys; sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'portbench' / 'tests')!r}]\n"
            "from pb_helpers import tiny\n"
            "from portbench import calibrate\n"
            "from portbench.faults import Patches\n"
            "from portbench.harness import kind_module, run_cell\n"
            f"over = tiny({cell!r})\n"
            f"a = run_cell({cell!r}, {SEED}, 0.2, False, device='cpu', overrides=over, stream=io.StringIO())\n"
            f"b = run_cell({cell!r}, {SEED}, 0.2, True, device='cpu', overrides=over, stream=io.StringIO())\n"
            "patches = Patches()\n"
            "kind_module('train_twin').stepped_twice(patches)\n"
            f"c = run_cell({cell!r}, {SEED}, 0.2, False, device='cpu', overrides=over, stream=io.StringIO())\n"
            "patches.undo()\n"
            f"plan = [p[0] for p in calibrate.plan({cell!r}, 12, 3, 3, 2)]\n"
            "print(json.dumps([a, b, c, over, plan]))\n")
    plain, traced, twice, over, plan = json.loads(_python(tmp_path, "-c", code).strip().splitlines()[-1])
    assert plain["correct"] and set(plain["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert traced["correct"] and set(traced["metrics"]) <= {m["name"] for m in manifest["per_layer"]}
    assert not twice["correct"] and twice["checks"]["grad_gap"]["value"] > twice["checks"]["grad_gap"]["limit"]
    assert over == {"cfg": {"batch_size": 32}, "traffic": {"warmup_steps": 4}}
    assert plan == ["program", "control", "half_batch", "stepped_twice", "program_fp32"]
    listed = _python(tmp_path, "-m", "pytest", "--collect-only", "-q", "-p", "no:cacheprovider",
                     "portbench/tests/test_pb_controls.py").splitlines()
    for case in ("test_fault_is_not_correct_cpu[ngp_twin.train-half_batch]",
                 "test_fault_is_not_correct_cpu[ngp_twin.train-stepped_twice]",
                 "test_fault_is_not_correct_card[ngp_twin.train-stepped_twice]",
                 "test_control_is_not_correct_cpu[ngp_twin.train]",
                 "test_fault_is_not_correct_cpu[ngp_dropin.train-unchanged]",
                 "test_fault_is_not_correct_cpu[ngp_dropin.extract-dropped_voxels]"):
        assert any(line.endswith("::" + case) for line in listed), (case, listed)
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there was edited
