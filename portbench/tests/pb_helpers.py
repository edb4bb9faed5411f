"""What the benchmark's tests share: the manifest, each cell's kind, and
the sizes at which a cell runs on the CPU in a few seconds."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2**31 + 987_654_321  # more than 32 signed bits hold, as a run's seed may
TINY = {
    "train": {"cfg": {"nerf_type": "small", "hash_n_levels": 8, "batch_size": 64, "N_samples": 8, "N_importance": 16,
                      "train_rays": 4096, "hidden_dim": 32},
              "traffic": {"warmup_steps": 4}},
    "render": {"cfg": {"nerf_type": "small", "hash_n_levels": 8, "N_samples": 8, "N_importance": 16},
               "traffic": {"frame": [24, 24], "chunk_rays": 128}},
    "extract": {"cfg": {"nerf_type": "small", "hash_n_levels": 8}, "traffic": {"resolution": 128}},
}


def kind_of(cell: str) -> str:
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    return json.loads((ROOT / "portbench" / "workloads" / f"{entry['traffic']}.json").read_text())["kind"]


def tiny(cell: str) -> dict:
    return json.loads(json.dumps(TINY[kind_of(cell)]))
